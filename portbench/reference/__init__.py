"""Plain reference of the benchmark's cells.

Plain PyTorch in float32 with TF32 off (and numpy on the host), written
from the published architecture and the host rules of the transcription
pipeline, frozen here so that later changes to the program cannot move it.
It imports neither JAX, nor the JAX package, nor anything of the PyTorch
port: it takes raw weights by parameter name (made by the benchmark from
the seed) and raw audio, and works out everything else itself.
"""
