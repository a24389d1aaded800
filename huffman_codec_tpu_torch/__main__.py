"""``python -m huffman_codec_tpu_torch``: the reference-compatible command
line of the port, on the CUDA device."""

import sys

from huffman_codec_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
