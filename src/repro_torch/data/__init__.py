"""Synthetic data sources (port of ``repro.data``)."""
from repro_torch.data.synthetic import Prefetcher, TokenStream, ZipfEventSource

__all__ = ["Prefetcher", "TokenStream", "ZipfEventSource"]
