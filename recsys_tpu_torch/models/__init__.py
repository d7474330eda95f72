"""Model layer: functions over nested dicts of tensors, with the JAX
package's param layout (``recsys_tpu/models``)."""

from recsys_tpu_torch.models.dcn import DeepCrossNetwork
from recsys_tpu_torch.models.multitask import ForwardOut, MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower

__all__ = ["TwoTower", "DeepCrossNetwork", "MultiTaskModel", "ForwardOut"]
