"""repro_torch.models — the language-model substrate of the port.

Counterpart of ``repro.models``: ``layers``, ``attention`` (GQA / MHA
self-attention, MLA, cross-attention), ``moe`` and ``moe_a2a`` (its
one-card path), ``ssm`` (the Mamba-2 SSD block), ``transformer`` and
``model``, for all ten architectures of ``configs``.  Training and mesh
sharding, the a2a exchange among them, come with ROADMAP A.13c.
"""
