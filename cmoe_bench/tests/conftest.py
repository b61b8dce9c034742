"""Few threads per test process: the toy cells are small, and several
test processes share the machine's cores."""

import torch

torch.set_num_threads(2)
