"""The forward of the stack-parallel layouts (the port's
``parallel/stacked.py``).

``make_composed_forward(model, stack_fn)`` is the model's own forward with
the encoder's loop over its layers replaced by ``stack_fn``: the conv
frontend, feature projection, SpecAugment, positional conv, pre-LN and
dropout before it, the final LN (stable-layer-norm backbones) and the heads
(``apply_heads``) after it run as they always do, on the same modules and
the same parameters, so checkpoints, FedAvg and export do not see the
layout. This is the JAX ``make_composed_forward``, which rebuilds the same
composition functionally around its ``stack_fn``:

  * ``parallel/pp.py`` plugs in the GPipe schedule over the ``pipe`` ranks,
  * ``parallel/sp.py`` the time-sharded layers over the ``seq`` ranks.

``stack_fn(encoder, x, frame_mask, seeds, b_offset) -> y`` receives the
encoder (its ``layers`` and ``run_layers``), the stack's input ``[B, T, D]``,
the frame mask ``[B, T]``, the attention-dropout seed of each layer (drawn
in layer order, as one device draws them) and the row offset of this rank's
batch. Like JAX, it requires the ``scan_layers`` layout (the Trainer's
``scan_layers=True``): the port computes the same either way, and keeps the
rule so that one configuration is valid in both packages.
"""

from __future__ import annotations

from typing import Callable

BEFORE_STACK = ("backbone.feature_extractor.", "backbone.feature_projection.",
                "backbone.masked_spec_embed", "backbone.encoder.pos_conv_embed.",
                "backbone.encoder.layers.")


def make_composed_forward(model, stack_fn: Callable) -> Callable:
    """Install ``stack_fn`` in ``model``'s encoder; returns the model's
    forward ``(input_values, input_lengths, **kw) -> DACSOutputs``."""
    enc = model.backbone.encoder
    if not getattr(enc, "scan_layers", False):
        raise ValueError(
            "stack-parallel forwards need the scan_layers (stacked "
            "[L, ...]) param layout — construct the Trainer/model with "
            "scan_layers=True")
    enc.stack_fn = stack_fn
    return model


def up_to_stack(name: str, cfg) -> bool:
    """Whether parameter ``name`` acts before the stack's exit (so a
    stack-parallel rank's gradient of it is a partial sum over the ranks):
    the frontend, the pre-stack encoder modules and the layers; the
    encoder's ``layer_norm`` is before the stack in post-norm backbones and
    after it in stable-layer-norm ones."""
    if name.startswith(BEFORE_STACK):
        return True
    return name.startswith("backbone.encoder.layer_norm.") and not cfg.do_stable_layer_norm
