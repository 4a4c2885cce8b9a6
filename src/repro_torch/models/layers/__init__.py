"""Model sublayers: RMSNorm, RoPE, the gated FFN and GQA attention."""
