"""Validator key custody (reference: privval/). The port's copy of
cometbft_tpu/privval/file_pv.py: FilePV, the file-backed signer with its
height/round/step double-sign guard. The remote signer comes in a later slice.
"""

from cometbft_tpu_torch.privval.file_pv import FilePV, PrivValidator  # noqa: F401
