"""Cost analysis of a step (port of ``repro.analysis``): ``cost`` counts
a step's per-rank FLOPs, bytes, collective bytes and peak live bytes
while it runs, where the JAX package walks compiled HLO."""
