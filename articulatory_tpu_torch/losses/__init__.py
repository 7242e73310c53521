"""GAN training losses (port of ``articulatory_tpu/losses``)."""

from articulatory_tpu_torch.losses.adversarial_loss import (  # noqa: F401
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from articulatory_tpu_torch.losses.feat_match_loss import FeatureMatchLoss  # noqa: F401
from articulatory_tpu_torch.losses.mel_loss import (  # noqa: F401
    MelSpectrogram,
    MelSpectrogramLoss,
)
from articulatory_tpu_torch.losses.stft_loss import (  # noqa: F401
    MultiResolutionSTFTLoss,
    STFTLoss,
)
