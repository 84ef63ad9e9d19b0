# -*- coding: utf-8 -*-
"""NetCDF-4 (HDF5) reader built on h5py, returning :class:`~xinvert_tpu_torch.field.Field`.

The reference test-suite loads fixtures with ``xarray.open_dataset`` (e.g.
xinvert's tests/test_Poisson.py).  Neither xarray nor netCDF4 is
available in this environment, but h5py is, and NetCDF-4 files are HDF5 files
following the dimension-scale convention.  This module implements the small
subset needed to read those fixtures.
"""
from __future__ import annotations

import numpy as np

from .field import Field

__all__ = ["open_dataset", "save_dataset", "Dataset"]


class Dataset(dict):
    """A dict of Fields with attribute access (ds.vor / ds['vor'])."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    @property
    def dims(self):
        out = {}
        for f in self.values():
            for d, n in zip(f.dims, f.shape):
                out[d] = n
        return out


def _dim_names(dset, fallback_prefix="phony_dim"):
    """Resolve the named dimensions of an HDF5 dataset (netCDF4 convention)."""
    names = []
    if "DIMENSION_LIST" in dset.attrs:
        f = dset.file
        try:
            for i, refs in enumerate(dset.attrs["DIMENSION_LIST"]):
                if len(refs):
                    scale = f[refs[0]]
                    names.append(scale.name.lstrip("/"))
                else:
                    names.append(f"{fallback_prefix}_{i}")
        except (OSError, TypeError):
            names = []
    if len(names) != dset.ndim:   # malformed/absent dimension list
        names = [f"{fallback_prefix}_{i}" for i in range(dset.ndim)]
    return names


def open_dataset(path):
    """Read a NetCDF-4/HDF5 file into a Dataset of Fields (eager, float64)."""
    import h5py

    ds = Dataset()
    with h5py.File(path, "r") as f:
        coord_vars = {}
        data_vars = {}
        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            cls = obj.attrs.get("CLASS")
            if isinstance(cls, bytes):
                cls = cls.decode("ascii", "ignore")
            is_scale = cls == "DIMENSION_SCALE"
            if is_scale:
                coord_vars[name] = np.asarray(obj[...])
            else:
                data_vars[name] = (_dim_names(obj), _read_values(obj))
        # coordinate variables that are also data (e.g. 2-D coords) are rare in
        # the fixtures; treat every scale as a 1-D coord.
        for name, (dims, vals) in data_vars.items():
            coords = {d: coord_vars[d] for d in dims if d in coord_vars}
            ds[name] = Field(vals, dims, coords, name=name)
        for name, vals in coord_vars.items():
            if name not in ds and vals.ndim == 1:
                ds[name] = Field(vals, (name,), {name: vals}, name=name)
    return ds


def save_dataset(ds, path):
    """Write a Dataset (or dict of Fields) as a NetCDF-4/HDF5 file.

    Emits the netCDF4 dimension-scale convention that :func:`open_dataset`
    (and xarray) read back: 1-D coordinate variables become dimension
    scales attached to the data variables.
    """
    import h5py
    from .field import Field, as_field

    fields = {k: as_field(v) for k, v in ds.items()}
    coords = {}
    for f in fields.values():
        for d in f.dims:
            if d in f.coords and d not in coords:
                coords[d] = np.asarray(f.coords[d])

    with h5py.File(path, "w") as h:
        for name, c in coords.items():
            dset = h.create_dataset(name, data=c)
            dset.attrs["CLASS"] = np.bytes_(b"DIMENSION_SCALE")
            dset.attrs["NAME"] = np.bytes_(name.encode())
        for name, f in fields.items():
            if name in coords:
                continue
            dset = h.create_dataset(name, data=np.asarray(f.values))
            for ax, d in enumerate(f.dims):
                if d in coords:
                    dset.dims[ax].attach_scale(h[d])
    return path


def _read_values(obj):
    vals = np.asarray(obj[...])
    # apply netCDF attribute conventions
    def scalar(attr):
        """Attributes are often stored as length-1 arrays; a raw array would
        broadcast 0-d values up a dimension in np.where."""
        v = obj.attrs.get(attr, None)
        return None if v is None else np.asarray(v).ravel()[0]

    if vals.dtype.kind in "iuf":
        vals = vals.astype(np.float64)
        fill = scalar("_FillValue")
        if fill is not None:
            vals = np.where(vals == fill, np.nan, vals)
        miss = scalar("missing_value")
        if miss is not None:
            vals = np.where(vals == miss, np.nan, vals)
        scale = scalar("scale_factor")
        offset = scalar("add_offset")
        if scale is not None:
            vals = vals * np.float64(scale)
        if offset is not None:
            vals = vals + np.float64(offset)
    return vals
