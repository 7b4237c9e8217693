"""The benchmark of autodiffusion_tpu_torch (see BENCHMARK.json)."""
