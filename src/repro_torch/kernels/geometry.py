"""The geometry of the split decode bodies (bf16 and fp32), of the fused
launches' schedule, of the bf16 SSD scan and of kernel 1's fp32 backward,
stated once.

``build.py`` passes these to ``nvcc`` as ``-D`` defines, and
``csrc/attention.cuh``, ``csrc/ssd_scan.cu`` and
``csrc/flash_attention_bwd.cu`` take them from there (they refuse to
compile without them); the wrappers size their launches and workspaces
with the same values. The module imports nothing, so
``build.py`` reads it without importing a wrapper.
"""

#: rows per tile of the bf16 split decode body (dense rows or paged rows)
SPLIT_TILE = 64
#: pieces per (slot, kv head) at most
MAX_SPLIT = 64
#: query heads per kv head the bf16 body takes (one 16-row tensor-core
#: operand)
SPLIT_G = 16
#: row tiles a piece takes at least, where there are enough: a piece's
#: fixed cost (its first loads, its partial's write and share of the merge)
#: outweighs a tile's
SPLIT_MIN_TILES = 2
#: rows per piece of the fp32 split decode body (a multiple of its 16-row
#: tile): each (slot, kv head)'s rows are cut into pieces of this many,
#: one CTA each, a count that depends on the rows alone
PIECE_ROWS = 64

#: SM ids the fused launches' schedule workspace holds a slot for (the
#: CTAs arrived and the rank of each SM id ``%smid`` below it; an id at or
#: above it shares the slot of its remainder)
SCHED_SMS = 1024
#: words of that workspace: the two queues' tickets, the CTAs that have
#: left and the SMs ranked, then the two per-SM tables
SCHED_WORDS = 8 + 2 * SCHED_SMS

#: rows and columns per tile of C Bᵀ in the bf16 SSD scan; its workspace
#: holds each chunk's Q rows rounded up to a whole tile
SSD_TILE = 64
#: columns of P per CTA of the bf16 SSD chunk walk (one of SSD_P_SLICES,
#: all three compiled; the default when the caller names none)
SSD_P_SLICE = 64
SSD_P_SLICES = (16, 32, 64)

#: query rows, and keys, per tile of kernel 1's fp32 backward
#: (``csrc/flash_attention_bwd.cu``) at D = 64 and 128, and at D = 256,
#: where one 64-row fp32 tile is 64 KB and two buffers of Q and dO beside
#: K and V would not fit an SM's shared memory
RT_BWD_TILE = 64
RT_BWD_TILE_WIDE = 32

#: the split decode's defines (``csrc/attention.cuh``), by name
DEFINES = {"SPLIT_TILE": SPLIT_TILE, "MAX_SPLIT": MAX_SPLIT,
           "SPLIT_G": SPLIT_G, "SPLIT_MIN_TILES": SPLIT_MIN_TILES,
           "PIECE_ROWS": PIECE_ROWS}
#: the fused launches' schedule's define (``csrc/attention.cu``), by name
SCHED_DEFINES = {"SCHED_SMS": SCHED_SMS}
#: the bf16 SSD scan's defines (``csrc/ssd_scan.cu``), by name
SSD_DEFINES = {"SSD_TILE": SSD_TILE, "SSD_P_SLICE": SSD_P_SLICE}
#: the fp32 flash backward's defines (``csrc/flash_attention_bwd.cu``)
BWD_DEFINES = {"RT_BWD_TILE": RT_BWD_TILE,
               "RT_BWD_TILE_WIDE": RT_BWD_TILE_WIDE}


def rt_bwd_tile(d: int) -> int:
    """Rows per tile of kernel 1's fp32 backward at head dim ``d``."""
    return RT_BWD_TILE_WIDE if d == 256 else RT_BWD_TILE


def slot_pieces(n_split: int, live: int) -> int:
    """Pieces of a launch's ``n_split`` per (slot, kv head) that a paged
    slot of ``live`` attended rows takes in the bf16 split body
    (``RowSource<DecodeArgs>::pieces`` in ``csrc/attention.cuh``): its own
    row tiles over SPLIT_MIN_TILES, at least 1, at most ``n_split``. With
    ``n_split`` the split count of a table that holds the slot, this is the
    split count at the slot's own rows, whatever the table's width."""
    tiles = -(-max(live, 0) // SPLIT_TILE)
    return max(1, min(tiles // SPLIT_MIN_TILES, n_split))


def fp32_pieces(rows: int) -> int:
    """Pieces of PIECE_ROWS rows that ``rows`` rows make, at least 1: the
    fp32 decode launch's pieces per (slot, kv head) over the dense cache's
    S rows or the table's n_b·ps, and a paged slot's own pieces over its
    live rows (``RowSource<...>::piece_count`` in ``csrc/attention.cuh``),
    so a slot's split depends on its own rows alone."""
    return max(1, -(-max(rows, 0) // PIECE_ROWS))


def all_defines() -> dict:
    """Every define the CUDA sources are compiled with (read at call time,
    so a changed value names another library)."""
    return {**DEFINES, **SCHED_DEFINES, **SSD_DEFINES, **BWD_DEFINES}
