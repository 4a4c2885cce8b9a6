"""The chunked SSD linear recurrence (Mamba-2 / mLSTM): plain version and
dispatcher (the kernel is ``kernels/ssd_scan``)."""
