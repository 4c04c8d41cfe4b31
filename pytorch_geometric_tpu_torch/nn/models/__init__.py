from .mlp import MLP
from .basic_gnn import (BasicGNN, EdgeCNN, GAT, GCN, GraphSAGE, GIN, PNA,
                        basic_gnn_inference)
from .autoencoder import ARGA, ARGVA, GAE, VGAE, InnerProductDecoder
from .misc_models import (JumpingKnowledge, DeepGraphInfomax, LightGCN,
                          LabelPropagation, CorrectAndSmooth, LINKX, PMLP,
                          MaskLabel, MetaLayer, NeuralFingerprint,
                          DeepGCNLayer, GraphUNet, HeteroJumpingKnowledge,
                          ARLinkPredictor, to_captum_model, to_captum_input,
                          captum_output_to_dicts)
from .node2vec import random_walk
from .transformers import GraphMixer, Polynormer, SGFormer
from .schnet import SchNet, GaussianSmearing
from .molecular import AttentiveFP, SignedGCN, RECT_L, GroupAddRev
from .dimenet import (DimeNet, DimeNetPlusPlus, BesselBasisLayer,
                      SphericalBasisLayer, Envelope)
# the JAX package re-exports the event container here (from its tgn.py)
from ...data.temporal import TemporalData

__all__ = ['MLP', 'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN', 'PNA',
           'EdgeCNN',
           'basic_gnn_inference', 'random_walk', 'SGFormer', 'Polynormer',
           'GraphMixer', 'InnerProductDecoder', 'GAE', 'VGAE', 'ARGA',
           'ARGVA', 'JumpingKnowledge', 'DeepGraphInfomax', 'LightGCN',
           'LabelPropagation', 'CorrectAndSmooth', 'LINKX', 'PMLP',
           'MaskLabel', 'MetaLayer', 'NeuralFingerprint', 'DeepGCNLayer',
           'GraphUNet',
           'HeteroJumpingKnowledge', 'ARLinkPredictor', 'to_captum_model',
           'to_captum_input', 'captum_output_to_dicts', 'SchNet',
           'GaussianSmearing', 'AttentiveFP', 'SignedGCN', 'RECT_L',
           'GroupAddRev', 'DimeNet', 'DimeNetPlusPlus', 'TemporalData']
