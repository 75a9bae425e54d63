"""The dense transformer LM (RMSNorm, GQA attention with RoPE, SwiGLU)."""
