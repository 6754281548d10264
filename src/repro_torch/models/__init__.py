"""Model code of the port: layers, attention ops and the paged
transformer (init, page pool, prefill, decode, fused group decode)."""
