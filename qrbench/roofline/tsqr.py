"""The TSQR of the block-angular step's bottom (``parallel/tsqr.py``:
``tsqr_factorize`` and ``tsqr_apply``, Householder QR through cuSOLVER's
``geqrf``): ``rows`` × ``n`` over ``shards`` row shards, and Qᵀ on the
rhs column."""


def cost(rows: int, n: int, shards: int = 1, itemsize: int = 4):
    """(bytes, operations) of the factorization and of Qᵀ on the rhs.
    The rows are zero-padded to ``shards`` shards of ``mloc = max(⌈rows /
    shards⌉, n)``; each shard's Householder QR takes ``2·mloc·n² −
    2n³/3`` operations, the second stage's QR of the ``shards·n × n``
    stack of their R factors ``2·(shards·n)·n² − 2n³/3``, and Qᵀ on the
    rhs ``4·mloc·n`` a shard and ``4·shards·n·n``.  Bytes: the bottom
    ``[rows, n + 1]`` read once, R ``[n, n]`` and y ``[n]`` written."""
    mloc = max(-(-rows // shards), n)
    qr = lambda m: 2 * m * n * n - 2 * n ** 3 / 3  # noqa: E731
    flops = shards * qr(mloc) + qr(shards * n) + 4 * shards * mloc * n + 4 * shards * n * n
    nbytes = itemsize * (rows * (n + 1) + n * n + n)
    return nbytes, flops
