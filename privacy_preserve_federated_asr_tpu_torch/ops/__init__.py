from .attention import (
    FlashAttention,
    attention_bwd_ref,
    attention_ref,
    flash_attention_bwd,
    flash_attention_fwd,
    multihead_attention,
)
from .ctc import ctc_loss
from .decode import ad_vote, greedy_ids
from .grl import gradient_reversal
from .gumbel import gumbel_softmax
from .losses import (
    am_softmax_loss,
    cross_entropy_loss,
    fsm_attention_loss,
    recall_family_loss,
)

__all__ = ["FlashAttention", "ad_vote", "am_softmax_loss", "attention_bwd_ref",
           "attention_ref", "cross_entropy_loss", "ctc_loss", "flash_attention_bwd",
           "flash_attention_fwd", "fsm_attention_loss", "gradient_reversal", "greedy_ids",
           "gumbel_softmax", "multihead_attention", "recall_family_loss"]
