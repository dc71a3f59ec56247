"""The LM harness's model zoo in PyTorch: the param-spec system (common),
attention/MLP/MoE blocks, SSM recurrences (Mamba2 SSD, RG-LRU) and the
pattern-stacked decoder (transformer) with forward and cached decode, plus
carrying a param tree across packages (convert)."""
