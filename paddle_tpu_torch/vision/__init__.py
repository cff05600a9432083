"""paddle_tpu_torch.vision — the port of `paddle_tpu/vision`: `models`
(the ResNet family and LeNet) and `datasets` (MNIST, FashionMNIST,
Cifar10, Cifar100).  The rest of the zoo, the other datasets,
`transforms`, `ops` and the image backends are still to come (ROADMAP.md
Queue 1 item 9)."""
from . import datasets, models

__all__ = ["datasets", "models"]
