"""GAN training (port of ``articulatory_tpu/train``)."""
