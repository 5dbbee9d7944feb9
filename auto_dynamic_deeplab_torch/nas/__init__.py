from .genotypes import (
    AUTODEEPLAB_GENOTYPE,
    NETWORK_ARCH,
    PRIMITIVES,
    SEARCH_C_INDEX,
    Genotype,
    load_genotype,
    num_edges,
)

__all__ = [
    "AUTODEEPLAB_GENOTYPE", "NETWORK_ARCH", "PRIMITIVES", "SEARCH_C_INDEX", "Genotype", "load_genotype", "num_edges",
]
