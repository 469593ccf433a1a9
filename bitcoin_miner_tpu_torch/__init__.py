"""bitcoin_miner_tpu_torch — the PyTorch/CUDA port of the mining system.

The JAX package ``bitcoin_miner_tpu`` is the reference; this package mirrors
its module names so each counterpart is easy to find, and imports neither
JAX nor anything of that package (it keeps its own copies of the pure-Python
modules it needs).

Layer map of the ported slice:

  L1  lspnet/    asyncio-UDP endpoints with the fault knobs and the seeded
                 chaos layer (NetSim)
  L2  lsp/       the LSP reliable, ordered transport
  L3  bitcoin/   application wire protocol + hashlib oracle
      ops/       SHA-256 host layout, the min-hash sweep, the Hopper kernel
                 (csrc/sha256_minhash.cu) and its plain PyTorch version
  L4  apps/      the server (scheduler), miner and client binaries, the
                 echo runners and the in-process chaos drill
      utils/     device probe, retry policy, metrics, tracing, the race
                 sanitizer, interval algebra, WFQ, atomic persistence

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); with no card and no such request they raise.
"""

__version__ = "0.1.0"
