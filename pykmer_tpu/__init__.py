"""pykmer_tpu — GPU k-mer counting and sample-comparison engine.

A from-scratch JAX/XLA re-design of the capabilities of sauloal/pykmer
(reference: /root/reference): FASTA → dense 4^K uint8 canonical k-mer coverage
array (`.kin` + `.kin.json`), N×N shared-kmer matrices (`.kma` + `.kma.json`),
and Jaccard-distance / neighbour-joining analysis outputs — with byte-identical
file formats, but computed by vectorised XLA programs sharded over device
meshes instead of pypy loops.

Layout
------
- ``formats``  : exact on-disk formats (.kin/.kin.json/.kma/.kma.json, GZI)
- ``io``       : FASTA decode, BGZF codec (C++-accelerated host pipeline)
- ``ops``      : single-chip device ops (canonical codes, saturating histogram)
- ``parallel`` : mesh sharding (count-space range shards, all-to-all exchange)
- ``index``    : the indexer pipeline (reference indexer.py semantics)
- ``merge``    : the N×N merge engine (reference merger.py semantics)
- ``analysis`` : Jaccard + clustering tail (reference calculate_distance.py)
- ``oracle``   : slow NumPy gold implementation used by the test-suite
"""

__version__ = "0.1.0"

FILE_VERSION = "KMER001"
