"""A tensor on neither the CPU nor the card nor the meta device, for the
tests of the kernels' device checks: CPU data whose ``device`` reads
``xla``, a device for which the port has no kernel and no plain version
(meta tensors get the kernels' output shapes, tests/test_torch_dryrun.py).
"""
import torch


class OffCard(torch.Tensor):
    @property
    def device(self):
        return torch.device("xla")


def off_card(t: torch.Tensor) -> torch.Tensor:
    """``t``'s data, on a device with no kernel."""
    return t.as_subclass(OffCard)
