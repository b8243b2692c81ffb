"""The paper's three serving payloads (Section 3): SqueezeNet v1.0 (5 MB),
ResNet-18 (45 MB), ResNeXt-50 (98 MB).  The full configs take 224 px
float32 images, the smoke configs 64 px."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig


def _cnn(name: str, variant: str) -> ModelConfig:
    return ModelConfig(name=name, family="cnn", cnn_variant=variant,
                       num_classes=1000, image_size=224,
                       param_dtype="float32", compute_dtype="float32")


SQUEEZENET = ArchSpec(
    arch_id="squeezenet", config=_cnn("squeezenet-v1.0", "squeezenet"),
    smoke=_cnn("squeezenet-v1.0", "squeezenet").replace(image_size=64),
    source="arXiv:1602.07360 (paper Section 3: 5 MB model)",
    long_strategy="skip", notes="paper payload; serving only")

RESNET18 = ArchSpec(
    arch_id="resnet18", config=_cnn("resnet-18", "resnet18"),
    smoke=_cnn("resnet-18", "resnet18").replace(image_size=64),
    source="arXiv:1512.03385 (paper Section 3: 45 MB model)",
    long_strategy="skip", notes="paper payload; serving only")

RESNEXT50 = ArchSpec(
    arch_id="resnext50", config=_cnn("resnext-50", "resnext50"),
    smoke=_cnn("resnext-50", "resnext50").replace(image_size=64),
    source="arXiv:1611.05431 (paper Section 3: 98 MB model)",
    long_strategy="skip", notes="paper payload; serving only")
