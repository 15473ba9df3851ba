from photon_tpu_torch.stat.feature_stats import FeatureDataStatistics

__all__ = ["FeatureDataStatistics"]
