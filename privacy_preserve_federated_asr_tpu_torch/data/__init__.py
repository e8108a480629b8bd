from .audio import load_audio, normalize_input_values, peak_normalize
from .tokenizer import CTCCharTokenizer

__all__ = ["CTCCharTokenizer", "load_audio", "normalize_input_values", "peak_normalize"]
