"""Card programs of the JAX package's Pallas experiments (scripts/exp_*.py).

One module a script, named after it, each with a ``main()`` for
``python -m ntsm_tpu_torch.experiments.<name>``:

* ``exp_pallas_gather`` (P1): a 1-D gather and take_along_axis(axis=0);
* ``exp_pallas_gather2`` (P2): take_along_axis along both axes and a row
  gather;
* ``exp_dma_probe`` (P3): random 512-B fingerprint rows fetched through a
  ring of asynchronous copies (16-B cp.async, one ring a warp) and
  XOR-reduced.

The gather forms' wrappers live in :mod:`.gather`, which P1 and P2 share;
their kernels are ``csrc/gather.cu`` and ``csrc/dma_probe.cu``.
"""
