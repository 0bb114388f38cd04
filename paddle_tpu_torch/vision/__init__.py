"""paddle.vision of the port: `models.LeNet` and `datasets.MNIST` /
`FashionMNIST`, what BASELINE config 1 (LeNet on MNIST through
`paddle.Model.fit`) needs. The rest of the JAX package's vision (the other
models and datasets, `transforms`, `ops`, the image backend) is ported
with ROADMAP A10d."""

from paddle_tpu_torch.vision import datasets, models  # noqa: F401
