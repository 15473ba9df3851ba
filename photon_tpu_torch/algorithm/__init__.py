"""photon_tpu_torch.algorithm"""
