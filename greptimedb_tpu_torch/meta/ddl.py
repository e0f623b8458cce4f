"""DDL procedures: journaled, resumable CREATE/DROP/ALTER TABLE.

Equivalent of the reference's DDL procedure layer
(src/common/meta/src/ddl/{create_table.rs,drop_table/,alter_table/} driven
by DdlManager, ddl_manager.rs:99): each DDL is a multi-step state machine
journaled through the procedure framework, so a crash between metadata
registration and region materialization resumes exactly where it stopped
instead of leaving a half-created table. Steps mirror the reference's
prepare → create-metadata → create-regions sequence; locks use the same
table-level exclusive keys as repartition (DDL key locks, rwlock.rs).
"""

from __future__ import annotations

import dataclasses

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.errors import RegionNotFound, StorageError
from greptimedb_tpu_torch.meta.procedure import Procedure, ProcedureContext, Status


def _db_service(ctx: ProcedureContext):
    return ctx.services["db"]


class CreateTableProcedure(Procedure):
    """state: {step, db, name, schema, engine, options, partition_exprs,
    partition_columns, num_regions, append_mode, info}"""

    type_name = "ddl/create_table"

    def lock_keys(self) -> list[str]:
        return [f"table/{self.state['db']}.{self.state['name']}"]

    def execute(self, ctx: ProcedureContext) -> Status:
        db = _db_service(ctx)
        st = self.state
        step = st.get("step", "metadata")
        if step == "metadata":
            # single kv put = the commit point. On resume, an existing
            # entry means a previous attempt already committed — adopt it.
            if db.catalog.table_exists(st["db"], st["name"]):
                info = db.catalog.get_table(st["db"], st["name"])
            else:
                info = db.catalog.create_table(
                    st["db"], st["name"], Schema.from_dict(st["schema"]),
                    engine=st["engine"], options=st["options"],
                    partition_exprs=st["partition_exprs"],
                    partition_columns=st["partition_columns"],
                    num_regions=st["num_regions"],
                )
            st["info"] = info.to_dict()
            st["step"] = "regions"
            return Status.executing()
        if step == "regions":
            if st["engine"] != "file":
                schema = Schema.from_dict(st["schema"])
                opts = None
                overrides = {}
                if st.get("append_mode"):
                    overrides["append_mode"] = True
                if st.get("ttl_ms"):
                    overrides["ttl_ms"] = int(st["ttl_ms"])
                if overrides:
                    opts = dataclasses.replace(
                        db.regions.default_options, **overrides
                    )
                for rid in st["info"]["region_ids"]:
                    # idempotent: adopts a region materialized by a prior
                    # attempt; real storage failures propagate untouched
                    db.regions.ensure_region(rid, schema, options=opts)
            return Status.done(output=st["info"])
        raise StorageError(f"create_table: unknown step {step!r}")


class AlterOptionsProcedure(Procedure):
    """state: {step, db, name, options} — journaled ALTER TABLE SET/UNSET
    of table options (``options`` is the full post-change dict).  Same
    crash-resume contract as the other DDL procedures: catalog commit
    first, then idempotent per-region manifest commits — a crash between
    them resumes and re-applies the region step."""

    type_name = "ddl/alter_options"

    def lock_keys(self) -> list[str]:
        return [f"table/{self.state['db']}.{self.state['name']}"]

    def execute(self, ctx: ProcedureContext) -> Status:
        db = _db_service(ctx)
        st = self.state
        step = st.get("step", "metadata")
        opts = st["options"]
        if step == "metadata":
            info = db.catalog.get_table(st["db"], st["name"])
            info.options = dict(opts)
            db.catalog.update_table(info)
            st["step"] = "regions"
            return Status.executing()
        if step == "regions":
            from greptimedb_tpu_torch.utils.config import parse_duration_ms

            overrides = {
                "ttl_ms": parse_duration_ms(opts["ttl"]) if opts.get("ttl")
                else None,
                "append_mode": str(opts.get("append_mode", "")).lower()
                in ("true", "1"),
            }
            if opts.get("compaction_window"):
                overrides["compaction_window_ms"] = parse_duration_ms(
                    opts["compaction_window"]) or 24 * 3600 * 1000
            info = db.catalog.get_table(st["db"], st["name"])
            for rid in info.region_ids:
                region = db.regions.regions.get(rid)
                if region is None:
                    try:
                        region = db.regions.open_region(rid)
                    except RegionNotFound:
                        continue  # file-engine/virtual: no LSM region
                region.options = dataclasses.replace(
                    region.options, **overrides)
                region.manifest.commit(
                    {"kind": "options",
                     "options": region.options.to_dict()}
                )
                region.apply_ttl()
                db.cache.invalidate_region(region.region_id)
            return Status.done()
        raise StorageError(f"alter_options: unknown step {step!r}")


class DropTableProcedure(Procedure):
    """state: {step, db, name, if_exists, info}"""

    type_name = "ddl/drop_table"

    def lock_keys(self) -> list[str]:
        return [f"table/{self.state['db']}.{self.state['name']}"]

    def execute(self, ctx: ProcedureContext) -> Status:
        import time as _time

        db = _db_service(ctx)
        st = self.state
        step = st.get("step", "metadata")
        if step == "metadata":
            # journal the victim's region list BEFORE deleting the catalog
            # entry — after the delete, only the journal knows what to drop
            if db.catalog.table_exists(st["db"], st["name"]):
                info = db.catalog.get_table(st["db"], st["name"])
                st["info"] = info.to_dict()
                st["step"] = "recycle"
                return Status.executing()
            if st.get("info") is not None:
                st["step"] = "regions"  # resume: entry already deleted
                return Status.executing(persist=False)
            return Status.done()  # if_exists pre-checked by the caller
        if step == "recycle":
            # soft delete (reference purge_dropped_table.rs): the catalog
            # entry moves to the recycle bin; region data stays on disk
            # until ADMIN undrop_table or a purge sweep.  Recycle-put is
            # idempotent on resume (same dropped_at key rewritten).
            from greptimedb_tpu_torch.meta.catalog import TableInfo

            info = TableInfo.from_dict(st["info"])
            if info.engine in ("mito", "metric_physical"):
                if "dropped_at_ms" not in st:
                    st["dropped_at_ms"] = int(_time.time() * 1000)
                db.catalog.recycle_put(info, st["dropped_at_ms"])
            st["step"] = "delete"
            return Status.executing()
        if step == "delete":
            db.catalog.drop_table(st["db"], st["name"], if_exists=True)
            st["step"] = "regions"
            return Status.executing()
        if step == "regions":
            info = st["info"]
            soft = info["engine"] in ("mito", "metric_physical")
            for rid in info["region_ids"]:
                if info["engine"] != "file":
                    if soft:
                        db.regions.close_region(rid)
                    else:
                        try:
                            db.regions.drop_region(rid)
                        except RegionNotFound:
                            pass  # resume: already dropped
                db.cache.invalidate_region(rid)
            return Status.done(output=info)
        raise StorageError(f"drop_table: unknown step {step!r}")


class AlterTableProcedure(Procedure):
    """state: {step, db, name, new_schema} — add/drop column paths (rename
    is a pure metadata CAS handled directly by the catalog)."""

    type_name = "ddl/alter_table"

    def lock_keys(self) -> list[str]:
        return [f"table/{self.state['db']}.{self.state['name']}"]

    def execute(self, ctx: ProcedureContext) -> Status:
        db = _db_service(ctx)
        st = self.state
        step = st.get("step", "metadata")
        new_schema = Schema.from_dict(st["new_schema"])
        if step == "metadata":
            info = db.catalog.get_table(st["db"], st["name"])
            info.schema = new_schema
            db.catalog.update_table(info)
            st["step"] = "regions"
            return Status.executing()
        if step == "regions":
            # flush-then-swap per region; re-running after a crash is safe
            # (flush of an empty memtable is a no-op, schema swap is
            # idempotent). Regions are opened if need be — on crash-resume
            # at startup nothing is open yet, and skipping would leave the
            # manifest schema permanently behind the catalog's.
            info = db.catalog.get_table(st["db"], st["name"])
            for rid in info.region_ids:
                region = db.regions.regions.get(rid)
                if region is None:
                    try:
                        region = db.regions.open_region(rid)
                    except RegionNotFound:
                        continue  # file-engine/virtual: no LSM region
                # under the region's (reentrant) write lock: concurrent
                # ingest-pool writers must not observe a half-applied
                # flush/schema swap
                with region._write_lock:
                    region.flush()
                    region.schema = new_schema
                    region.manifest.commit(
                        {"kind": "schema", "schema": new_schema.to_dict()}
                    )
                    region.memtable.schema = new_schema
                db.cache.invalidate_region(region.region_id)
            view = db._views.pop(f"{st['db']}.{st['name']}", None)
            if view is not None:
                db.cache.invalidate_region(view.region_id)
            return Status.done()
        raise StorageError(f"alter_table: unknown step {step!r}")
