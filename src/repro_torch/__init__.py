"""repro_torch — the PyTorch/CUDA port of the ``repro`` APSP package.

Mirrors ``repro``'s module names (``core``, ``kernels``, ``apsp``,
``serve``, ``launch``, ``configs``, ``models``, ``utils``) and never
imports JAX or ``repro``.  The fused and 4-dispatch
Floyd-Warshall rounds (the fused one also in bf16, f16, saturating int16
and bit-packed or_and storage), the semiring matmul, the repairs and
single-token decode attention run as hand-written CUDA kernels for Hopper
(sm_90a); every kernel has a plain torch version beside it that runs on
the CPU.  The language models of ``configs`` (the attention families)
run in plain torch ops, as the reference's run in XLA ops.

    from repro_torch.apsp import solve
    res = solve(w)                  # on the card
    res = solve(w, device="cpu")    # plain versions on the host
"""
