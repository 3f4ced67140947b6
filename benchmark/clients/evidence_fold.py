"""The client ``evidence_fold``: binary images are folded, on the device,
into the naive-Bayes program's evidence parameters, one a (class, pixel)
in class-major order,

    e[c, i] = x_i theta[c, i] + (1 - x_i) (1 - theta[c, i]),

so that ``observe x_i ~ Bernoulli(theta[c, i])`` becomes the structural
``observe 1 ~ Bernoulli($e<c>_<i>)`` (the client code of the port's
``examples/digit_serving_torch.py::evidence_params``).  The served answer
is the class posterior, the masses normalized on the host by their sum.
"""

from __future__ import annotations


class Client:
    def __init__(self, config: dict, data: dict, device):
        import torch

        self.torch, self.device = torch, device
        self.theta = torch.as_tensor(data["theta"], dtype=torch.float64,
                                     device=device)

    def send(self, inputs):
        torch = self.torch
        x = torch.as_tensor(inputs["images"], dtype=torch.float64,
                            device=self.device)[:, None, :]
        th = self.theta[None]
        e = x * th + (1.0 - x) * (1.0 - th)
        return e.reshape(x.shape[0], -1)

    def receive(self, raw):
        return raw / raw.sum(axis=1, keepdims=True)
