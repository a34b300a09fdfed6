"""repro_torch: the PyTorch/CUDA port of the SubGraph2Vec counting system.

A package beside ``repro`` (the JAX reference, which it never imports).
Module names follow the reference's, so each module's counterpart is easy
to find.  The engine runs on a CUDA card unless the caller passes
``device="cpu"``; its ``blocked`` backend launches hand-written CUDA
kernels (:mod:`repro_torch.kernels`), and every other path is plain
PyTorch.
"""
