"""repro_torch.checkpoint"""
