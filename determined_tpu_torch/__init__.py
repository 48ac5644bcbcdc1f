"""determined_tpu_torch: the PyTorch and CUDA port of determined_tpu.

The JAX package ``determined_tpu`` is the reference and stays as it is; this
package grows beside it slice by slice and imports nothing of it (nor JAX,
flax, optax or orbax).  Every TPU kernel on a ported path becomes a kernel
written by hand for Hopper (``csrc/``), with a plain PyTorch version beside
it.  Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: the serving path of the flagship decoder-only LM
(``models/transformer.py``, ``serve/``) and its training path
(``train/``, ``data/``, ``core/``, ``config/``, ``LMTrial``), with the
flash attention forward and backward kernels (``ops/flash_attention.py``,
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) and the fused AdamW kernel
(``ops/fused_adamw.py``, ``csrc/fused_adamw.cu``); the local experiment
(``experiment/``, checkpoints, preemption, restarts) and hyperparameter
search (``searcher/``: ASHA, adaptive ASHA, Hyperband, PBT with clones
restored from checkpoints, the simulator) with the MNIST trial
(``models/mnist.py``); later slices are listed in ROADMAP.md, the latest
the cluster path (``api/``, ``exec/run_trial.py``, ``exec/launcher.py``,
``experiment/cluster.py``: trials placed by the native master on its
agents).
"""
