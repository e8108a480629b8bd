from .backbone import SSLBackbone, feat_extract_output_lengths
from .config import BackboneConfig, DACSConfig
from .dacs import DACSModel, DACSOutputs
from .port import init_dacs_state_dict, state_dict_from_flax, state_dict_from_hf
from .recipes import RECIPES, Recipe, get_recipe

__all__ = [
    "BackboneConfig", "DACSConfig", "DACSModel", "DACSOutputs", "RECIPES",
    "Recipe", "SSLBackbone", "feat_extract_output_lengths", "get_recipe",
    "init_dacs_state_dict", "state_dict_from_flax", "state_dict_from_hf",
]
