"""photon_tpu_torch.cli"""
