from .attention import attention_ref, flash_attention_fwd, multihead_attention
from .decode import ad_vote, greedy_ids
from .gumbel import gumbel_softmax

__all__ = ["ad_vote", "attention_ref", "flash_attention_fwd", "greedy_ids",
           "gumbel_softmax", "multihead_attention"]
