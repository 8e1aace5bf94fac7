"""The benchmark's plain reference of MOVEDepth (float32 PyTorch). It
imports neither JAX nor any package of the repository."""
