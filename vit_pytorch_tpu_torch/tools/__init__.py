"""The port's bench tools: the JAX package's layer prototypes in ``tools/``
(``bench_layer_fused``, ``bench_stack_fusion``, ``fused_block_proto``,
``bench_fused_tuning``), with the same names, on the port's Hopper kernels.

Each module's ``main()`` (``tune_kernel()`` for the tuning tool) times its
functions on a CUDA card and raises without one::

    python -m vit_pytorch_tpu_torch.tools.bench_layer_fused
"""
