from .resnet import build_resnet, build_resnet50, build_resnet101  # noqa: F401
