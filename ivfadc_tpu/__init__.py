"""ivfadc_tpu — an IVFADC approximate-nearest-neighbor engine in JAX.

Built from scratch in JAX/XLA with the capability surface of
JuliaNeighbors/IVFADC.jl (reference exports at /root/reference/src/IVFADC.jl:16-20):
`IVFADCIndex`, `knn_search`, `delete_from_index`, `save_ivfadc_index`,
`load_ivfadc_index`, plus the Base-method extensions push!/pushfirst!/pop!/
popfirst!/length/size re-expressed as methods (`push`, `push_front`, `pop`,
`pop_front`, `len()`, `.shape`).
"""

from ivfadc_tpu.config import IVFADCConfig
from ivfadc_tpu.models.index import IVFADCIndex
from ivfadc_tpu.ops.metrics import Metric, get_metric, register_metric
from ivfadc_tpu.ops.pq import ProductQuantizer
from ivfadc_tpu.serving import BatchingSearcher

__version__ = "0.4.0"


def knn_search(index, points, k: int, w: int = 1):
    """Free-function parity with the reference's exported `knn_search`
    (/root/reference/src/index.jl:204-273). Single point or batch; works
    on plain and `ShardedIVFADCIndex` indexes alike."""
    return index.search(points, k, w=w)


def delete_from_index(index: IVFADCIndex, ids) -> None:
    """Parity with `delete_from_index!` (/root/reference/src/utils.jl:90-105).
    Takes 0-based external ids (the reference takes 1-based positions)."""
    index.delete(ids)


def save_ivfadc_index(path: str, index: IVFADCIndex) -> None:
    index.save(path)


def load_ivfadc_index(path: str) -> IVFADCIndex:
    return IVFADCIndex.load(path)


def __getattr__(name: str):
    # lazy: the distributed layer (mesh construction, shard_map programs)
    # only loads when a user actually reaches for it
    if name == "ShardedIVFADCIndex":
        from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
        return ShardedIVFADCIndex
    if name == "make_mesh":
        from ivfadc_tpu.parallel.mesh import make_mesh
        return make_mesh
    raise AttributeError(f"module 'ivfadc_tpu' has no attribute {name!r}")


__all__ = [
    "BatchingSearcher", "IVFADCConfig", "IVFADCIndex", "Metric",
    "ProductQuantizer", "ShardedIVFADCIndex", "get_metric", "make_mesh",
    "register_metric", "knn_search", "delete_from_index",
    "save_ivfadc_index", "load_ivfadc_index",
]
