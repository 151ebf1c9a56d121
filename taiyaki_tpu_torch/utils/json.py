"""JSON encoder for model export (port of taiyaki_tpu/utils/json.py).

Serialises numpy scalars and arrays, and PyTorch tensors, so that the
layers' `json()` structures dump directly to Guppy-loadable JSON.
"""

import json

import numpy as np
import torch


class JsonEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().numpy().tolist()
        return super().default(obj)
