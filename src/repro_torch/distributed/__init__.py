"""Training-side distributed pieces (port of ``repro.distributed``): the
AdamW optimizer, the async checkpointer, the gradient-compression
collectives, and ``sharding``, which maps the model's logical axes to a
``DeviceMesh`` as DTensor placements."""
