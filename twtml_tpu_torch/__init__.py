"""twtml-tpu on PyTorch and CUDA: the port of ``twtml_tpu`` to one NVIDIA H100.

The JAX package ``twtml_tpu`` stays the reference; this package mirrors its
module names so each piece can be held against its counterpart. It imports
``torch`` and numpy, never ``jax`` and nothing of ``twtml_tpu``: what it needs
from there it keeps as its own copy.

Ported so far (the flagship trainer on the padded units wire):

- ``config``           — the flags the linear-regression app takes
- ``features``         — hashing ground truth, batch containers, featurizer
- ``streaming.sources`` — replay-file and synthetic tweet generators
- ``ops``              — device hashing, densify, stats, quality vector, and
                         the fused dense-SGD loop (``ops/fused_sgd.py``, a
                         hand-written CUDA kernel in ``csrc/fused_sgd.cu``)
- ``models``           — the dense streaming SGD step and the linear learner
- ``convert``          — weights to and from the JAX package's models
- ``apps.linear_regression`` — the flagship app

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
GPU they raise instead of running quietly on the CPU.
"""

__version__ = "0.1.0"
