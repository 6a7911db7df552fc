"""Tiny sizes of the cells for CPU tests: every width cut, the layer
pattern kept (NSA with all three branches, MoE, mHC)."""

LM = dict(vocab_size=300, d_model=32, num_layers=2, num_heads=2, head_dim=16, max_seq_len=128,
          num_experts=4, expert_hidden_dim=64, window_size=16, compression_ratio=4,
          top_k_global=8, num_streams=4, sinkhorn_iterations=3)
TRAIN = dict(batch=2, seq_len=64, slow_loop_interval=3, trace_seconds=0.5)
SERVE = dict(rows=4, rate_per_s=6.0, prompt=dict(median=24, sigma=0.8, min=8, max=64),
             output=dict(median=8, sigma=0.7, min=4, max=32), warmup_requests=3,
             check_tokens=60, trace_seconds=0.5, drain_s=20)
CLIP = dict(image_size=32, patch_size=16, vocab_size=100, max_text_len=8, embed_dim=8,
            vision=dict(d_model=32, num_layers=2, num_heads=1, head_dim=64, mlp_hidden_dim=48,
                        dropout_rate=0.0),
            text=dict(d_model=32, num_layers=2, num_heads=1, head_dim=64, mlp_hidden_dim=40,
                      dropout_rate=0.0))
CLIP_TRAIN = dict(batch=4, text_len=dict(min=2, max=8), slow_loop_interval=3, trace_seconds=0.5)
