"""twtml-tpu on PyTorch and CUDA: the port of ``twtml_tpu`` to one NVIDIA H100.

The JAX package ``twtml_tpu`` stays the reference; this package mirrors its
module names so each piece can be held against its counterpart. It imports
``torch`` and numpy, never ``jax`` and nothing of ``twtml_tpu``: what it needs
from there it keeps as its own copy.

Ported so far (the flagship trainer's single-host streaming runtime, on
the JAX package's default wires: the ragged units packed into one buffer
back to back, the padded units under a wall clock):

- ``config``           — the flags the linear-regression app takes
- ``features``         — hashing ground truth, batch containers and the
                         packed wire, featurizer, the native host library
                         (``native/*.cpp`` built with g++) with its one-pass
                         fill and pack, host hashing, and the buffer arena
- ``streaming``        — supervised sources (replay, synthetic, queue, the
                         live Twitter stream with OAuth1 signing) and the
                         StreamingContext with its bounded intake queue
- ``telemetry``        — metrics registry, publish breaker, the dashboard's
                         JSON types, web and Lightning clients, SessionStats
- ``web``              — the twtml-web dashboard server on the standard
                         library (HTTP routes, RFC 6455 websockets, assets)
- ``ops``              — wire decode (delta cumsum, re-pad), device hashing,
                         densify, stats, quality vector, and
                         the fused dense-SGD loop (``ops/fused_sgd.py``, a
                         hand-written CUDA kernel in ``csrc/fused_sgd.cu``)
- ``models``           — the dense streaming SGD step and the linear learner
- ``convert``          — weights to and from the JAX package's models
- ``serving``          — verified snapshots and their promotion, the
                         predict step (the train step at zero iterations),
                         the coalescing serve plane, its client and the
                         read-fleet router
- ``apps``             — the fetch pipeline and watchdog, the warm-up
                         (``apps/common.py``), the training apps, and the
                         serve and router entry points
- ``utils``            — rounding, device selection, the clock seam, logging,
                         the ``--profileDir`` tracer (torch.profiler)

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
GPU they raise instead of running quietly on the CPU.
"""

__version__ = "0.1.0"
