"""The split decode bodies' geometry, stated once.

``build.py`` passes these to ``nvcc`` as ``-D`` defines, and
``csrc/attention.cuh`` takes them from there (it refuses to compile
without them); the wrappers size their launches and workspaces with the
same values. The module imports nothing, so ``build.py`` reads it without
importing a wrapper.
"""

#: rows per tile of the bf16 split decode body (dense rows or paged rows)
SPLIT_TILE = 64
#: pieces per (slot, kv head) at most
MAX_SPLIT = 64
#: query heads per kv head the bf16 body takes (one 16-row tensor-core
#: operand)
SPLIT_G = 16

#: the defines the CUDA sources are compiled with, by name
DEFINES = {"SPLIT_TILE": SPLIT_TILE, "MAX_SPLIT": MAX_SPLIT,
           "SPLIT_G": SPLIT_G}
