"""The client ``params``: each batch's parameter rows (``params``, float64)
are handed to the program as they are; the served answer is the masses
it returns."""

from __future__ import annotations


class Client:
    def __init__(self, config: dict, data: dict, device):
        import torch

        self.torch, self.device = torch, device

    def send(self, inputs):
        return self.torch.as_tensor(inputs["params"], dtype=self.torch.float64,
                                    device=self.device)

    def receive(self, raw):
        return raw
