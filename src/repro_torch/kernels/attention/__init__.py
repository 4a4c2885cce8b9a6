"""Attention: the plain version and the dispatcher of the flash attention
kernel (``kernels/flash_attention``)."""
