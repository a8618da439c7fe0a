"""portbench: the benchmark of kslam_tpu_torch, the PyTorch/CUDA port.

One run drives the port's chunk pipeline in steady state against a
database made from the seed, then holds what the window produced to a
plain reference (portbench/reference) and prints one JSON line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in the
repository's BENCHMARK.json; each lives in a file of its own here
(configs/, traffic/, metrics/, roofline/), found by its name.  Nothing
in this package imports jax or the JAX package (kslam_tpu); the
reference imports nothing of kslam_tpu_torch either.
"""
