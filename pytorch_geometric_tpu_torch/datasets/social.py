"""Social, web and citation network datasets (the long tail).

Counterpart of ``pytorch_geometric_tpu/datasets/social.py``, with its numpy
and scipy parsing, so the same raw files give the JAX package's graphs bit
for bit. Reference parsers: ``torch_geometric/datasets/citation_full.py``
(npz), ``deezer_europe.py`` / ``facebook.py`` / ``github.py`` /
``lastfm_asia.py`` / ``twitch.py`` (npz with ``features`` / ``edges`` /
``target``), ``gemsec.py``, ``airports.py`` (an edge list and a label
file), ``polblogs.py``, ``email_eu_core.py``, ``wiki_cs.py`` (json),
``ppi.py`` (graph json and npy), ``heterophilous_graph_dataset.py`` (npz),
``linkx_dataset.py`` (mat), ``bitcoin_otc.py`` (csv), ``elliptic.py``
(csv), ``attributed_graph_dataset.py``, ``snap_dataset.py``. Raw files go
under ``root/raw`` (``root/<name>/raw`` for the named ones); nothing is
downloaded.
"""

import json
import os.path as osp
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from ..utils.coalesce import coalesce, to_undirected
from .npz_datasets import read_npz


def _und(coo, n):
    return to_undirected(np.asarray(coo, np.int64), num_nodes=n).astype(
        np.int32)


class _Named(InMemoryDataset):
    """A dataset kept under ``root/<name>``, ``name`` lower-cased."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower()
        super().__init__(osp.join(root, self.name), **kwargs)


class CitationFull(_Named):
    """Full citation graphs Cora / Cora_ML / CiteSeer / DBLP / PubMed
    (reference ``citation_full.py``; npz format)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.npz']

    def process(self):
        self.save([read_npz(osp.join(self.raw_dir, self.raw_file_names[0]))])


class CoraFull(CitationFull):
    """(reference ``citation_full.py:CoraFull``)."""

    def __init__(self, root: str, **kwargs):
        super().__init__(root, 'cora', **kwargs)


def _features_target_edges(path: str) -> Data:
    """An npz of ``features``, ``target`` and ``edges`` ``[E, 2]``, the
    stored direction kept (reference ``facebook.py``, ``deezer_europe.py``
    and the others)."""
    with np.load(path, allow_pickle=True) as f:
        x = f['features'].astype(np.float32)
        y = f['target'].astype(np.int32)
        edges = f['edges'].T.astype(np.int32)
    return Data(x=x, edge_index=edges, y=y, num_nodes=x.shape[0])


class DeezerEurope(InMemoryDataset):
    """(reference ``deezer_europe.py``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['deezer_europe.npz']

    def process(self):
        self.save([_features_target_edges(
            osp.join(self.raw_dir, self.raw_file_names[0]))])


class LastFMAsia(DeezerEurope):
    """(reference ``lastfm_asia.py``; the same npz layout)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['lastfm_asia.npz']


class FacebookPagePage(InMemoryDataset):
    """(reference ``facebook.py``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['facebook.npz']

    def process(self):
        self.save([_features_target_edges(
            osp.join(self.raw_dir, self.raw_file_names[0]))])


class GitHub(FacebookPagePage):
    """(reference ``github.py``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['github.npz']


class Twitch(FacebookPagePage):
    """(reference ``twitch.py``), one npz a country under
    ``root/<NAME>``."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.upper()
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.npz']


class GemsecDeezer(InMemoryDataset):
    """(reference ``gemsec.py``): an npz of ``target`` and ``edges``; no
    node features, multi-label genre targets."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.npz']

    def process(self):
        with np.load(osp.join(self.raw_dir, self.raw_file_names[0]),
                     allow_pickle=True) as f:
            y = f['target'].astype(np.int32)
            edges = f['edges'].T.astype(np.int32)
        n = int(edges.max()) + 1 if edges.size else y.shape[0]
        n = max(n, y.shape[0])
        self.save([Data(edge_index=edges, y=y, num_nodes=n)])


class Airports(_Named):
    """USA / Brazil / Europe airports (reference ``airports.py``): an edge
    list and a label file over raw airport ids; features are the one-hot
    node ids; the stored direction is kept (``airports.py:92``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}-airports.edgelist',
                f'labels-{self.name}-airports.txt']

    def process(self):
        labels = np.genfromtxt(
            osp.join(self.raw_dir, self.raw_file_names[1]),
            skip_header=1, dtype=np.int64)
        ids = labels[:, 0]
        remap = {int(v): i for i, v in enumerate(ids)}
        y = labels[:, 1].astype(np.int32)
        n = len(ids)
        edges = np.genfromtxt(
            osp.join(self.raw_dir, self.raw_file_names[0]), dtype=np.int64)
        coo = np.asarray([[remap[int(a)], remap[int(b)]]
                          for a, b in edges]).T
        coo = coalesce(coo, num_nodes=n)
        self.save([Data(x=np.eye(n, dtype=np.float32),
                        edge_index=coo.astype(np.int32), y=y,
                        num_nodes=n)])


class PolBlogs(InMemoryDataset):
    """(reference ``polblogs.py``; the stored direction kept)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['adjacency.tsv', 'labels.tsv']

    def process(self):
        coo = np.genfromtxt(osp.join(self.raw_dir, 'adjacency.tsv'),
                            dtype=np.int64).T[:2]
        y = np.genfromtxt(osp.join(self.raw_dir, 'labels.tsv'),
                          dtype=np.int64).astype(np.int32)
        self.save([Data(edge_index=coo.astype(np.int32), y=y,
                        num_nodes=len(y))])


class EmailEUCore(InMemoryDataset):
    """(reference ``email_eu_core.py``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['email-Eu-core.txt', 'email-Eu-core-department-labels.txt']

    def process(self):
        coo = np.genfromtxt(osp.join(self.raw_dir, self.raw_file_names[0]),
                            dtype=np.int64).T
        lab = np.genfromtxt(osp.join(self.raw_dir, self.raw_file_names[1]),
                            dtype=np.int64)
        n = int(lab[:, 0].max()) + 1
        y = np.zeros(n, np.int32)
        y[lab[:, 0]] = lab[:, 1]
        self.save([Data(edge_index=coo.astype(np.int32), y=y,
                        num_nodes=n)])


class WikiCS(InMemoryDataset):
    """(reference ``wiki_cs.py``): a json of features, links and labels
    with 20 train / val split masks and one test mask."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['data.json']

    def process(self):
        with open(osp.join(self.raw_dir, 'data.json')) as f:
            d = json.load(f)
        x = np.asarray(d['features'], np.float32)
        y = np.asarray(d['labels'], np.int32)
        n = x.shape[0]
        rows, cols = [], []
        for i, nbrs in enumerate(d['links']):
            rows += [i] * len(nbrs)
            cols += nbrs
        data = Data(x=x, edge_index=_und(np.stack([rows, cols]), n), y=y,
                    num_nodes=n)
        data.train_mask = np.asarray(d['train_masks'], bool).T
        data.val_mask = np.asarray(d['val_masks'], bool).T
        data.test_mask = np.asarray(d['test_mask'], bool)
        self.save([data])


class PPI(InMemoryDataset):
    """Protein-protein interaction graphs (reference ``ppi.py``): a graph
    json with every split's links, and npy features, labels and graph ids;
    one symmetrised ``Data`` a graph."""

    def __init__(self, root: str, split: str = 'train', **kwargs):
        self.split = split
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        s = self.split
        return [f'{s}_graph.json', f'{s}_feats.npy', f'{s}_labels.npy',
                f'{s}_graph_id.npy']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return [f'{self.split}.pt']

    def process(self):
        raw = self.raw_dir
        with open(osp.join(raw, self.raw_file_names[0])) as f:
            g = json.load(f)
        x = np.load(osp.join(raw, self.raw_file_names[1]))
        y = np.load(osp.join(raw, self.raw_file_names[2]))
        gid = np.load(osp.join(raw, self.raw_file_names[3]))
        coo = np.asarray([[link['source'], link['target']]
                          for link in g['links']]).T
        out = []
        for graph in np.unique(gid):
            mask = gid == graph
            idx = np.nonzero(mask)[0]
            remap = np.full(len(gid), -1)
            remap[idx] = np.arange(len(idx))
            emask = mask[coo[0]] & mask[coo[1]]
            sub = remap[coo[:, emask]]
            out.append(Data(x=x[mask].astype(np.float32),
                            edge_index=_und(sub, len(idx)),
                            y=y[mask].astype(np.float32),
                            num_nodes=len(idx)))
        self.save(out)


class HeterophilousGraphDataset(InMemoryDataset):
    """Roman-empire / Amazon-ratings / ... (reference
    ``heterophilous_graph_dataset.py``): an npz of node features, labels,
    edges and ``[N, 10]`` split masks; symmetrised."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower().replace('-', '_')
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.npz']

    def process(self):
        with np.load(osp.join(self.raw_dir, self.raw_file_names[0])) as f:
            x = f['node_features'].astype(np.float32)
            y = f['node_labels'].astype(np.int32)
            coo = f['edges'].T.astype(np.int64)
            tr = f['train_masks'].T.astype(bool)
            va = f['val_masks'].T.astype(bool)
            te = f['test_masks'].T.astype(bool)
        n = x.shape[0]
        d = Data(x=x, edge_index=_und(coo, n), y=y, num_nodes=n)
        d.train_mask, d.val_mask, d.test_mask = tr, va, te
        self.save([d])


class LINKXDataset(_Named):
    """penn94 / genius / ... (reference ``linkx_dataset.py``): a ``.mat``
    file read by ``scipy.io``; the stored direction kept."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.mat']

    def process(self):
        from scipy.io import loadmat
        m = loadmat(osp.join(self.raw_dir, self.raw_file_names[0]))
        A = m['A'].tocoo() if hasattr(m['A'], 'tocoo') else m['A']
        coo = np.stack([A.row, A.col]).astype(np.int64)
        feats = m.get('node_feat', m.get('local_info'))
        x = np.asarray(feats, np.float32) if feats is not None else None
        y = np.asarray(m['label']).ravel().astype(np.int32)
        self.save([Data(x=x, edge_index=coo.astype(np.int32), y=y,
                        num_nodes=len(y))])


class BitcoinOTC(InMemoryDataset):
    """A weighted signed trust network over time (reference
    ``bitcoin_otc.py``): csv rows of source, target, rating, time, cut
    into snapshots."""

    def __init__(self, root: str, edge_window_size: int = 10, **kwargs):
        self.edge_window_size = edge_window_size
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['soc-sign-bitcoinotc.csv']

    def process(self):
        # reference bitcoin_otc.py:33-71: min-shifted node ids, integer
        # ratings, 13.8-day time bins (138 snapshots on the real data),
        # each snapshot holding the sliding window of the previous
        # ``edge_window_size`` bins
        rows = np.genfromtxt(osp.join(self.raw_dir, self.raw_file_names[0]),
                             delimiter=',')
        ei = rows[:, :2].astype(np.int64)
        ei = (ei - ei.min()).T
        n = int(ei.max()) + 1
        rating = rows[:, 2].astype(np.int64)
        stamps = rows[:, 3].astype(np.int64)
        offset = int(13.8 * 24 * 3600)
        graph_idx = np.empty(len(stamps), np.int64)
        factor = 1
        for i, t in enumerate(stamps):
            if not t < stamps[0] + factor * offset:
                factor += 1
            graph_idx[i] = factor - 1
        out = []
        for i in range(int(graph_idx.max()) + 1):
            mask = (graph_idx > (i - self.edge_window_size)) \
                & (graph_idx <= i)
            out.append(Data(edge_index=ei[:, mask].astype(np.int32),
                            edge_attr=rating[mask], num_nodes=n))
        self.save(out)


class EllipticBitcoinDataset(InMemoryDataset):
    """(reference ``elliptic.py``): features, edges and classes csv;
    class '1' illicit (1), '2' licit (0), 'unknown' 2; time steps 1-34
    train, 35-49 test, unknowns in neither (``elliptic.py:44-46``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['elliptic_txs_features.csv', 'elliptic_txs_edgelist.csv',
                'elliptic_txs_classes.csv']

    def process(self):
        feat = np.genfromtxt(osp.join(self.raw_dir, self.raw_file_names[0]),
                             delimiter=',')
        ids = feat[:, 0].astype(np.int64)
        remap = {int(v): i for i, v in enumerate(ids)}
        x = feat[:, 2:].astype(np.float32)
        edges = np.genfromtxt(
            osp.join(self.raw_dir, self.raw_file_names[1]), delimiter=',',
            skip_header=1, dtype=np.int64)
        coo = np.asarray([[remap[int(a)], remap[int(b)]]
                          for a, b in edges if int(a) in remap
                          and int(b) in remap]).T
        classes = np.genfromtxt(
            osp.join(self.raw_dir, self.raw_file_names[2]), delimiter=',',
            skip_header=1, dtype=str)
        y = np.full(len(ids), 2, np.int32)
        for cid, c in classes:
            if c == '1':
                y[remap[int(cid)]] = 1
            elif c == '2':
                y[remap[int(cid)]] = 0
        d = Data(x=x, edge_index=coo.astype(np.int32), y=y,
                 num_nodes=len(ids))
        time_step = feat[:, 1].astype(np.int64)
        d.train_mask = (time_step < 35) & (y != 2)
        d.test_mask = (time_step >= 35) & (y != 2)
        self.save([d])


class AttributedGraphDataset(_Named):
    """Wiki / BlogCatalog / ... (reference
    ``attributed_graph_dataset.py``): a scipy sparse ``attrs.npz``, an
    edge list and a label file; the stored direction kept."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['attrs.npz', 'edgelist.txt', 'labels.txt']

    def process(self):
        import scipy.sparse as sp
        x = sp.load_npz(osp.join(self.raw_dir, 'attrs.npz')).todense() \
            .astype(np.float32)
        coo = np.genfromtxt(osp.join(self.raw_dir, 'edgelist.txt'),
                            dtype=np.int64).T
        lab = np.genfromtxt(osp.join(self.raw_dir, 'labels.txt'),
                            dtype=np.int64)
        n = x.shape[0]
        y = np.zeros(n, np.int32)
        y[lab[:, 0]] = lab[:, 1]
        self.save([Data(x=np.asarray(x), edge_index=coo.astype(np.int32),
                        y=y, num_nodes=n)])


class SNAPDataset(_Named):
    """Generic SNAP edge-list graphs (reference ``snap_dataset.py``),
    node ids renumbered in sorted order."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.txt']

    def process(self):
        coo = np.genfromtxt(osp.join(self.raw_dir, self.raw_file_names[0]),
                            dtype=np.int64, comments='#').T
        uniq, inv = np.unique(coo, return_inverse=True)
        coo = inv.reshape(coo.shape)
        self.save([Data(edge_index=coo.astype(np.int32),
                        num_nodes=len(uniq))])
