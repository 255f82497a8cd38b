"""Multi-GPU rendering over torch.distributed (counterpart of
liverrenderer_tpu/parallel): see mesh.py."""
