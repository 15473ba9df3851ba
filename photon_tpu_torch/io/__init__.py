"""photon_tpu_torch.io"""
