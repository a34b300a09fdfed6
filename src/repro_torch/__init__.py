"""repro_torch: the PyTorch/CUDA port of the SubGraph2Vec counting system
and of its model substrate: LM inference and single-device training, GNN
training, and the two-tower recommender, trained and served.

A package beside ``repro`` (the JAX reference, which it never imports).
Module names follow the reference's, so each module's counterpart is easy
to find.  Entry points run on a CUDA card unless the caller passes
``device="cpu"``.  The counting engine's ``blocked`` backend and the LM's
cache-free forward with ``attn_impl="flash"`` launch hand-written CUDA
kernels (:mod:`repro_torch.kernels`); every other path is plain PyTorch.
"""
