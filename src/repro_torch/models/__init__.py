"""repro_torch.models — the language-model substrate of the port.

Counterpart of ``repro.models`` for the attention families (GQA / MHA
self-attention, cross-attention, dense FFNs): ``layers``, ``attention``,
``transformer`` and ``model``.  MoE, MLA and SSM layers raise
``NotImplementedError`` (ROADMAP A.13b).
"""
