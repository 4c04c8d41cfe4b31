"""Datasets. Counterpart of ``pytorch_geometric_tpu/datasets``, so far:
``FakeDataset``, ``planetoid_like``, ``TUDataset``, ``Planetoid``, the npz
datasets, the big single graphs, the social and web graphs, the synthetic
generators, the mesh, point-cloud, molecular and temporal datasets and the
graph and motif generator subpackages. Each parses raw
files already under its root (nothing is downloaded) into host tensors."""

from . import graph_generator, motif_generator
from .fake import FakeDataset, planetoid_like
from .tu_dataset import TUDataset
from .planetoid import Planetoid
from .npz_datasets import (Amazon, Coauthor, WebKB, WikipediaNetwork, Actor,
                           read_npz)
from .big_graphs import Reddit, Reddit2, Flickr, Yelp, AmazonProducts, NELL
from .social import (CitationFull, CoraFull, DeezerEurope, LastFMAsia,
                     FacebookPagePage, GitHub, Twitch, GemsecDeezer,
                     Airports, PolBlogs, EmailEUCore, WikiCS, PPI,
                     HeterophilousGraphDataset, LINKXDataset, BitcoinOTC,
                     EllipticBitcoinDataset, AttributedGraphDataset,
                     SNAPDataset)
from .geometry import (ModelNet, FAUST, MD17, QM9, MovieLens, JODIEDataset,
                       parse_sdf)
from .molecules import (ZINC, AQSOL, MoleculeNet, GNNBenchmarkDataset,
                        MNISTSuperpixels, LRGBDataset, MalNetTiny)
from .point_datasets import (GeometricShapes, SHREC2016, MedShapeNet,
                             Teeth3DS, CoMA, TOSCA, PCPNetDataset, ShapeNet,
                             S3DIS, DynamicFAUST, PascalPF, WILLOWObjectClass)
from .generators import (KarateClub, StochasticBlockModelDataset,
                         ExplainerDataset, FakeHeteroDataset, ba_graph,
                         BAShapes, BA2MotifDataset, BAMultiShapesDataset,
                         InfectionDataset, MixHopSyntheticDataset,
                         RandomPartitionGraphDataset)

__all__ = [
    'FakeDataset', 'planetoid_like', 'KarateClub',
    'StochasticBlockModelDataset', 'ExplainerDataset', 'FakeHeteroDataset',
    'ba_graph', 'BAShapes', 'BA2MotifDataset', 'BAMultiShapesDataset',
    'InfectionDataset', 'MixHopSyntheticDataset',
    'RandomPartitionGraphDataset', 'Planetoid', 'TUDataset', 'Amazon',
    'Coauthor', 'WebKB', 'WikipediaNetwork', 'Actor', 'read_npz',
    'CitationFull', 'CoraFull', 'DeezerEurope', 'LastFMAsia',
    'FacebookPagePage', 'GitHub', 'Twitch', 'GemsecDeezer', 'Airports',
    'PolBlogs', 'EmailEUCore', 'WikiCS', 'PPI', 'HeterophilousGraphDataset',
    'LINKXDataset', 'BitcoinOTC', 'EllipticBitcoinDataset',
    'AttributedGraphDataset', 'SNAPDataset', 'Reddit', 'Reddit2', 'Flickr',
    'Yelp', 'AmazonProducts', 'NELL', 'ModelNet', 'FAUST', 'MD17', 'QM9',
    'MovieLens', 'JODIEDataset', 'parse_sdf', 'ZINC', 'AQSOL', 'MoleculeNet',
    'GNNBenchmarkDataset', 'MNISTSuperpixels', 'LRGBDataset', 'MalNetTiny',
    'GeometricShapes', 'SHREC2016', 'MedShapeNet', 'Teeth3DS', 'CoMA',
    'TOSCA', 'PCPNetDataset', 'ShapeNet', 'S3DIS', 'DynamicFAUST',
    'PascalPF', 'WILLOWObjectClass',
]
