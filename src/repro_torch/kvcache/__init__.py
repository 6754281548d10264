"""Host-side block allocator of the paged KV pool."""
