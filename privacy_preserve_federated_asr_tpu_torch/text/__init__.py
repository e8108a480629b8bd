"""The text branch (the port's ``text/``): session documents, prompts and
LLM clients (stdlib/numpy copies of the JAX package's), the BERT encoder,
the frozen-embedding classifier and the end-to-end fine-tune in PyTorch,
the 0207_DM_* experiment registry, and the SSL audio backends."""

from .session import SessionUtterance, assemble_sessions, parse_path
from .prompts import (
    PSYCHOLOGY_TEMPLATE,
    SENSITIVE_REPLACE_DICT,
    apply_sensitive_replacements,
    assessment_prompt,
    load_sensitive_dict,
    summary_prompt,
)
from .llm_client import (
    LLMClientConfig,
    OpenAIChatClient,
    OpenAIEmbeddingsClient,
    make_embed_fn,
    make_llm_fn,
)
from .experiments import (
    BACKEND_DIMS,
    EXPERIMENTS,
    ExperimentSpec,
    InputSpec,
    run_experiment,
)
from .bert import BertConfigT, BertEncoder, WordPieceTokenizer, port_hf_bert
from .classifier import TextClassifier, TextClassifierConfig, TextTrainer
from .finetune import (
    FinetuneConfig,
    FinetuneTextModel,
    FinetuneTextTrainer,
    FinetuneTrainerConfig,
)
from .audio_backend import audio_backends_for, make_ssl_audio_backend

__all__ = [
    "SessionUtterance",
    "assemble_sessions",
    "parse_path",
    "PSYCHOLOGY_TEMPLATE",
    "SENSITIVE_REPLACE_DICT",
    "apply_sensitive_replacements",
    "assessment_prompt",
    "load_sensitive_dict",
    "summary_prompt",
    "BACKEND_DIMS",
    "EXPERIMENTS",
    "ExperimentSpec",
    "InputSpec",
    "run_experiment",
    "LLMClientConfig",
    "OpenAIChatClient",
    "OpenAIEmbeddingsClient",
    "make_embed_fn",
    "make_llm_fn",
    "BertConfigT",
    "BertEncoder",
    "WordPieceTokenizer",
    "port_hf_bert",
    "TextClassifier",
    "TextClassifierConfig",
    "TextTrainer",
    "FinetuneConfig",
    "FinetuneTextModel",
    "FinetuneTextTrainer",
    "FinetuneTrainerConfig",
    "audio_backends_for",
    "make_ssl_audio_backend",
]
