"""S²C² on PyTorch and CUDA: the port of the JAX package ``repro``.

It follows ``repro``'s layout and names.  ``core`` holds the coding algebra,
the Algorithm-1 allocators, the coded matvec on one device, the speed traces
and the LSTM predictor; ``kernels`` holds the hand-written Hopper kernels
with their plain PyTorch versions; ``cluster`` the coded-execution engine;
``configs`` and ``models`` the architectures and the decoder LM;
``runtime.serve_loop`` and ``launch.serve`` serving with the coded lm_head;
``convert`` carries the JAX package's parameters across.  Entry points default to ``device="cuda"`` and raise
when there is no card, unless the caller passes ``device="cpu"``.
"""
