"""By-path access to the circuit artifacts shipped in zerokit_tpu/resources/.

The artifacts (proving keys and witness graphs) are data shared with the JAX
package. They are read by path, so this package never imports zerokit_tpu
(whose __init__ pulls in JAX).
"""

import os

RESOURCE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "zerokit_tpu", "resources")
)


def resource_path(rel: str) -> str:
    return os.path.join(RESOURCE_DIR, rel)


def load_resource(rel: str) -> bytes:
    with open(resource_path(rel), "rb") as f:
        return f.read()


def load_circuit(tree_depth: int):
    """(Zkey, Graph) of the embedded single-message RLN circuit at this depth."""
    from .circuit.graph import graph_from_bytes
    from .circuit.zkey import zkey_from_bytes

    base = f"tree_depth_{tree_depth}"
    zkey = zkey_from_bytes(load_resource(f"{base}/rln_final.arkzkey"))
    graph = graph_from_bytes(load_resource(f"{base}/graph.bin"), tree_depth)
    return zkey, graph
