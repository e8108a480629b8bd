from .extract import (
    ExtractionRow,
    columns_to_pickle,
    extract_embeddings,
    read_records,
    rows_to_pickle,
    write_results_csv,
)
from .detail_wer import detailed_wer_report, MMSE_BANDS
from .svm_ad import predict_ad_svm, speaker_vote_metrics
from .feat_scoring import mask_node_statistics, per_utt_on_rates
from .forced_toggle import mask_off_n_groups, aggressive_passive_masking

__all__ = [
    "ExtractionRow",
    "columns_to_pickle",
    "extract_embeddings",
    "read_records",
    "rows_to_pickle",
    "write_results_csv",
    "detailed_wer_report",
    "MMSE_BANDS",
    "predict_ad_svm",
    "speaker_vote_metrics",
    "mask_node_statistics",
    "per_utt_on_rates",
    "mask_off_n_groups",
    "aggressive_passive_masking",
]
