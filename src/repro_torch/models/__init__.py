"""The LM workload on PyTorch: the reference's model zoo (``repro.models``)
as plain functions on tensors.

Parameters are the reference's nested dict with the same keys and the same
layer-stacked layout, so one tree serves both packages.  This slice covers
the serving (forward) path of the ``dense``, ``ssm`` and ``hybrid``
families with GQA attention; MLA, MoE and the modality frontends come in a
later slice.
"""
from repro_torch.models.common import ModelConfig  # noqa: F401
