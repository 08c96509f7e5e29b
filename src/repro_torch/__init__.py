"""PyTorch/CUDA port of the federated AdaLD system in ``repro``.

The package mirrors ``repro``'s module layout so each counterpart is easy
to find.  It imports torch and numpy, never jax and nothing of ``repro``:
the reference package is only ever reached from the parity tests.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
the hand-written CUDA kernels live in :mod:`repro_torch.kernels`.
"""
