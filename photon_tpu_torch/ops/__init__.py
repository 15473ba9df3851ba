"""photon_tpu_torch.ops"""
