from .engine import STAGE_NETWORK, FederatedConfig, FederatedEngine
from .privacy import DpAccountant, epsilon_for_rounds, noise_for_epsilon, rdp_sampled_gaussian

__all__ = ["STAGE_NETWORK", "DpAccountant", "FederatedConfig", "FederatedEngine",
           "epsilon_for_rounds", "noise_for_epsilon", "rdp_sampled_gaussian"]
