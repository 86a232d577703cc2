"""Exception types (analog of numpywren/exceptions.py)."""


class NumpywrenTpuError(Exception):
    """Base class for all framework errors."""


class TiledProgramExecutionError(NumpywrenTpuError):
    """A task inside a tiled program raised during execution.

    Analog of the reference's LambdaPackExecutionError: carries the node id
    (statement index + loop-variable values) whose kernel failed.
    """

    def __init__(self, node, cause):
        self.node = node
        self.cause = cause
        super().__init__(f"node {node} failed: {cause!r}")


class BlockNotFoundError(NumpywrenTpuError):
    """get_block on a block that was never written and has no parent_fn."""


class CompilationError(NumpywrenTpuError):
    """DSL program failed to parse/analyze/lower."""


class ShapeError(NumpywrenTpuError):
    """Tile/matrix shape mismatch."""
