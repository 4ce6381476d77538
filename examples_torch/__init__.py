"""The examples of ``examples/`` on the PyTorch port, one file each under
the same name, with the same ``main`` keywords and defaults.

Each ``main`` runs on the GPU in float32 unless told otherwise
(``device="cpu"``, ``dtype=torch.float64``, ``backend="torch"`` runs it on
the CPU), prints what the JAX example prints and makes its assertions.
Each file's ``run`` returns the arrays ``main`` prints and asserts on.
Run one on a card from the repository root:
``python3 examples_torch/<name>.py``.
"""
