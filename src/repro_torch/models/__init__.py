"""The LM workload on PyTorch: the reference's model zoo (``repro.models``)
as plain functions on tensors.

Parameters are the reference's nested dict with the same keys and the same
layer-stacked layout, so one tree serves both packages.  Every family of
the reference is here: ``dense``, ``moe`` (GQA or MLA attention, the MTP
head), ``ssm``, ``hybrid`` and the modality frontends ``audio`` and
``vlm``, whose stub embeddings go before the tokens.
"""
from repro_torch.models.common import ModelConfig  # noqa: F401
