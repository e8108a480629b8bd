from .backbone import SSLBackbone, feat_extract_output_lengths
from .config import BackboneConfig, DACSConfig
from .dacs import DACSModel, DACSOutputs
from .port import (
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
    state_dict_from_hf,
)
from .recipes import RECIPES, Recipe, get_recipe, validate_stage

__all__ = [
    "BackboneConfig", "DACSConfig", "DACSModel", "DACSOutputs", "RECIPES",
    "Recipe", "SSLBackbone", "feat_extract_output_lengths", "flax_from_state_dict",
    "get_recipe", "init_dacs_state_dict", "state_dict_from_flax",
    "state_dict_from_hf", "validate_stage",
]
