from cometbft_tpu_torch.node.node import Node, init_files

__all__ = ["Node", "init_files"]
