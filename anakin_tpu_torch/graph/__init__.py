from .ir import Graph, GraphBuilder, Node, topological_order  # noqa: F401
