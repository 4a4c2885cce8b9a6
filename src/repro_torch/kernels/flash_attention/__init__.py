"""Flash attention forward: the CUDA kernel (its plain version and
dispatcher are ``kernels/attention``)."""
