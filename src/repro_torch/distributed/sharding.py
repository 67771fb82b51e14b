"""Where the paged serving cache's tensors live on a mesh (the port of
`repro.distributed.sharding.paged_pool_pspecs`; the rest of that module,
the parameter, cache and batch specs of training under a mesh, waits for
the port's sharded training)."""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed import api as dist_api


def paged_pool_pspecs(mesh, *, quantized: bool = False,
                      rules: Optional[dict] = None) -> dict:
    """Specs of the paged cache (`serving/kvcache.PagedCache`), as tuples
    of `resolve_spec`: payload pools (L, P, Hkv, page, Dh) and scale pools
    (L, P, Hkv, page) shard their KV-head axis over the mesh dimension
    behind the logical "model" name, so each rank holds 1/tp of every page;
    lengths and block tables are replicated (admission, scheduling, COW
    forks, rewind and swap are host-side and run on every rank). Returns
    {"pools", "scales", "lengths", "block_tables"}; "scales" is None for
    fp pools."""
    pool = dist_api.resolve_spec((None, None, "model", None, None), mesh, rules)
    return {"pools": pool, "lengths": (), "block_tables": (),
            "scales": pool[:4] if quantized else None}
