"""Plain PyTorch references of the configurations, in fp32 with TF32 off:
``bench/reference/<config>.py`` beside ``bench/configs/<config>.json``.
They import nothing of the program (``repro_torch``), of the JAX package
(``repro``) or of jax, and take from the benchmark only the seed's inputs:
the weights it drew and the tokens it sent."""
