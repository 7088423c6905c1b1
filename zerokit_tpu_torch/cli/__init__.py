"""CLI frontends mirroring the reference's rln-cli examples
(rln-cli/src/examples/{relay,stateless,multi_message_id,partial}.rs):

    python -m zerokit_tpu_torch.cli.relay --demo
    python -m zerokit_tpu_torch.cli.stateless --demo
    python -m zerokit_tpu_torch.cli.multi_message_id --demo
    python -m zerokit_tpu_torch.cli.partial --demo

Each runs interactively by default and scripted with --demo. Each takes
--device (default cuda: it raises without a card; --device cpu runs on the
CPU) and builds its RLN engine and every tree on that device. The JAX
package's XLA cache setup has no counterpart: the kernels' nvcc build at
first use (ff/_cuda.py) is kept under build/ and reused.
"""
