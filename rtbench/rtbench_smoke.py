"""Small shapes for the CPU tests: the cells' two families at sizes a test
run holds, the engine row cut to few slots."""

DENSE = {"family": "dense", "num_layers": 2, "d_model": 128,
         "vocab_size": 2048, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 32, "d_ff": 512, "mlp_act": "gelu", "rope_theta": 1e5,
         "norm_eps": 1e-6, "tie_embeddings": False,
         "param_dtype": "bfloat16"}

MOE = {"family": "moe", "num_layers": 2, "d_model": 128, "vocab_size": 2048,
       "num_heads": 4, "num_kv_heads": 2, "head_dim": 32, "d_ff": 512,
       "mlp_act": "swiglu", "num_experts": 8, "experts_per_token": 2,
       "moe_d_ff": 128, "num_shared_experts": 1, "num_dense_layers": 1,
       "capacity_factor": 1.25, "rope_theta": 5e4, "norm_eps": 1e-6,
       "tie_embeddings": False, "param_dtype": "bfloat16"}

BY_FAMILY = {"dense": DENSE, "moe": MOE}


def small_cell(cell, rate: float = 16.0):
    """``cell`` at the small shapes: 8 slots, budget 40, 2 epochs of
    m_theta, a short warm-up, a fixed rate."""
    import dataclasses
    engine = dict(cell.engine, num_slots=8, token_budget=40)
    traffic = dict(cell.traffic, profile_epochs=2, warmup_s=0.25,
                   check_tokens=400)
    return dataclasses.replace(cell, engine=engine, traffic=traffic,
                               rate=rate)
