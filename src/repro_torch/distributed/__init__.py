"""Training-side distributed pieces (port of ``repro.distributed``): the
AdamW optimizer, the async checkpointer and the gradient-compression
collectives, on one card.  The JAX package's ``sharding`` module (logical
axes to a device mesh) waits for ROADMAP queue 1 item 16b."""
