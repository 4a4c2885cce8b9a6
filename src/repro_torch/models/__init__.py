"""The model stack: configs, layers, the layer stack and the LM entry
points (prefill / decode) for the dense decoder."""
