"""The port's benchmark entry points, counterparts of the JAX package's
``bench.py`` and ``scripts/{bench_kernels,roofline,bench_http}.py``:

  python -m tlsan_tpu_torch.bench.train      # train examples/s, one JSON line
  python -m tlsan_tpu_torch.bench.kernels    # K1/K2/K3 against their plain versions
  python -m tlsan_tpu_torch.bench.roofline   # the train step by stage
  python -m tlsan_tpu_torch.bench.http --model_dir DIR   # HTTP serving

Each runs on CUDA unless given ``--device cpu``; with no GPU and no
``--device cpu`` it raises.  `data` reads the packed train set, `bounds`
holds the card's peaks, the least time each measured function could take
and the device-time reading of a profiled call.
"""
