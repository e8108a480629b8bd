"""Named spans of the port's hot paths (the port's ``utils/profiling.py``).

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler records, and otherwise returns one shared no-op context: the
guard costs well under a microsecond where an unguarded range costs
microseconds even with no profiler. The ranges are the profiler's own
events, so they sit on the device trace's clock beside the kernels they
launch; whoever runs ``torch.profiler`` around ``cli train`` sees them.
Nothing is written anywhere else.

The spans of one train step (``train/trainer.py``, ``train/steps.py``,
``ops/ctc.py``):

  * ``dacs.train.step``: the whole step, the cache gather included,
  * ``dacs.train.gather``: the row gather (and crop) from the trainer's
    cache of frozen forwards,
  * ``dacs.train.forward``: the encoder and heads forward,
  * ``dacs.train.loss``: the objectives,
  * ``dacs.ctc.forward``: ``ctc_loss``, the alpha recursion included,
  * ``dacs.train.backward``: ``loss.backward()``,
  * ``dacs.ctc.backward``: the CTC beta recursion and posterior, on
    autograd's thread,
  * ``dacs.train.optim``: gradient norm, clipping, AdamW and the schedule.

And of the encoder's positional convolution (``models/backbone.py``), in
every forward that runs it:

  * ``dacs.encoder.pos_conv``: ``PositionalConvEmbedding.forward``, the
    stacked and the single kind.

The JAX module's ``enable_tpu_fast_rng`` (switch JAX's PRNG to the TPU's
hardware RBG) has no meaning in torch and has no counterpart here.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; else the shared no-op context. The guard reads the profiler's
    process-wide Python flag: ``torch.autograd._profiler_enabled()`` reads
    the calling thread's state, which a profiler of all threads
    (``profile_all_threads``) leaves unset."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
