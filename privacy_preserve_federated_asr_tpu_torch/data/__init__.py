from .audio import load_audio, normalize_input_values, peak_normalize
from .collate import Batch, LengthBucketBatcher, pad_batch
from .dataset import AsrExample, csv_to_examples, load_spk2label, prepare_examples
from .tokenizer import CTCCharTokenizer

__all__ = ["AsrExample", "Batch", "CTCCharTokenizer", "LengthBucketBatcher",
           "csv_to_examples", "load_audio", "load_spk2label", "normalize_input_values",
           "pad_batch", "peak_normalize", "prepare_examples"]
