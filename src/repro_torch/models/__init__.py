"""Model code of the port: layers, attention ops, the Mamba-2 SSD and
RG-LRU blocks, and the transformer (init, page pool, dense slot cache,
prefill with an encoder or a frontend, chunked prefill, decode, fused
group decode, forward). The models-level entry points are
re-exported here, as the JAX package's ``repro.models`` exports them."""

from repro_torch.models.rglru import RGLRUState, rglru_block  # noqa: F401
from repro_torch.models.ssm import SSDState, ssd_block  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, encode, forward, init_cache, init_params, prefill,
    prefill_chunk, supports_paged_cache)
