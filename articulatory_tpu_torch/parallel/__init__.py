"""Data, tensor, pipeline and sequence parallelism on ``torch.distributed``
and CUDA streams (port of ``articulatory_tpu/parallel``)."""
