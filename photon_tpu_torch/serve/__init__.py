"""photon_tpu_torch.serve"""
