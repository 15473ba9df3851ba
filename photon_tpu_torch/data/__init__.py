"""photon_tpu_torch.data"""
