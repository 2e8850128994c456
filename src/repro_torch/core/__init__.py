"""The paper's technique inside the model: locality-aware MoE routing."""
