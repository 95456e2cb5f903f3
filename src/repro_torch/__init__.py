"""PyTorch/CUDA port of the Bit-GraphBLAS library (``repro``).

Same module layout as the JAX package; packed words are ``torch.int32``
bit patterns (see ``repro_torch.core.words``). Entry points take
``device=None``, meaning ``"cuda"``: they raise when no card is present
unless the caller asks for ``device="cpu"``.

This package imports ``torch``, numpy and the standard library only.
"""
