"""photon_tpu_torch.models"""
