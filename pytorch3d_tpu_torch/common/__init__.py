"""Shared helpers of the port."""

import torch

# Every constructor and entry point of the port runs on the card unless the
# caller passes another device.
DEFAULT_DEVICE = torch.device("cuda")
