"""photon_tpu_torch.estimators"""
