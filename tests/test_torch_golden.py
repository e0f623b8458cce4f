"""Port parity on the golden corpus: ``tests/golden/*.sql`` through the
PyTorch port on the CPU.

Each listed file runs through ``tests/test_golden.py``'s own ``_run_case``
and ``_rows_match`` (numeric cells within ``1e-5*max(1,|b|)``), with its
``GreptimeDB`` swapped for the port's on ``device="cpu"`` through
``monkeypatch``, so the reference's own golden test in the same worker
sees its own class again.  The list is every golden file the port
answers whole: the dense grid, all of PromQL, the SQL row path, the
sketch aggregates, flows, full-text and vector search.  Files that need
what the port has not ported yet (joins, subqueries, DDL beyond CREATE,
the expression-key fold, ...) stay out; ``ROADMAP.md`` queue A names them.
"""

import os

import pytest
import test_golden as tg

from greptimedb_tpu_torch.standalone import GreptimeDB

PORTED = [
    "02_insert_select", "03_aggregates", "04_time_buckets",
    "05_where_predicates", "06_null_handling", "07_order_limit", "11_tql",
    "12_explain_errors", "13_range_query", "14_functions",
    "16_window_functions", "17_string_functions", "18_case_cast",
    "19_math_functions", "20_having_distinct", "22_geo_ip",
    "23_json_functions", "26_append_mode", "27_interval_dates",
    "38_zero_row_semantics", "39_order_by_nulls", "40_between_like_in",
    "41_numeric_types", "42_ts_precisions", "44_having_advanced", "46_casts",
    "47_string_functions2", "49_upsert_dedup", "54_limit_edge",
    "55_distinct_forms", "56_range_fill", "57_time_functions",
    "58_is_null_coalesce", "59_date_functions2", "60_group_by_month",
    "63_null_functions", "64_string_pad_repeat", "65_count_variants",
    "68_window_frames", "72_boolean_logic", "73_arithmetic_edge",
    "74_range_sliding", "75_multi_field_wide", "76_order_by_expr",
    "77_like_escapes", "78_insert_forms", "86_json_more", "87_geo_more",
    "88_interval_arith", "90_multi_tag_groupby", "91_negative_timestamps",
    "92_empty_table_paths", "93_wide_rows_select_star", "94_case_forms",
    "95_first_last_order", "97_like_ordering_tags", "98_range_by_fill_linear",
    "99_window_more", "102_agg_expressions", "103_tag_only_queries",
    "104_division_modulo_nulls", "105_quoted_identifiers",
    "108_count_over_groups", "109_having_without_select",
    "110_append_mode_dups", "113_anomaly_windows", "119_order_multi_key",
    "120_limit_in_groupby", "124_is_distinct", "128_sliding_windows",
    "129_numeric_precision", "130_distinct_on_expr",
    "131_time_range_variants", "132_or_predicates",
    "133_agg_filtered_columns", "135_tag_value_edge", "136_unicode_strings",
    "139_prepared_like_params", "140_group_by_ordinal", "142_many_groups",
    "143_between_times_strings", "144_column_alias_scope",
    "145_mixed_agg_forms", "147_null_tag_rows", "148_large_in_list",
    "151_range_aligned_window", "152_range_unaligned_window",
    "153_range_by_tags", "154_range_minmax_aligned",
    "155_range_sliding_aligned", "156_range_post_ingest",
    "157_range_tag_filter", "158_range_nulls", "159_range_groupby_trunc",
    "160_range_mixed_alignments", "163_range_filtered_windows",
    "164_range_count_sum_mix", "167_range_empty_windows",
    "168_range_single_series", "169_range_groupby_trunc_filter",
    "171_tql_fused_sum_rate", "175_tql_fused_instant",
    # the rest of PromQL: every window kind, the window-matrix functions,
    # quantile/topk/bottomk, binary operators, @ and subqueries
    "50_tql_functions2", "51_tql_aggregations2", "52_tql_binary_ops",
    "70_tql_range_eval", "83_tql_label_functions", "84_tql_histogram",
    "85_scalar_vector_tql", "106_tql_offset_at", "107_tql_missing_metric",
    "121_promql_functions3", "122_changes_idelta", "134_tql_range_syntax",
    "141_promql_subquery", "146_tql_modifier_group",
    "172_tql_fused_gauge_aggs", "173_tql_fused_counter_rc",
    "174_tql_fused_irate", "176_tql_subquery_nested_agg",
    "177_tql_subquery_gauge", "178_tql_fused_deriv_offset",
    "179_tql_fused_group_without", "180_tql_fusion_mixed",
    # sketches (hll/uddsketch states, their merges and INSERT ... SELECT)
    # and flows
    "21_sketches", "37_approx_sketch_agg", "111_uddsketch_merge_golden",
    "112_hll_merge_golden", "80_flows_batching",
    # INSERT ... SELECT; full-text search (matches / matches_term)
    "114_insert_select_into", "30_fulltext_log", "118_matches_fulltext2",
    # vector search (vec_cos_distance / vec_l2sq_distance /
    # vec_dot_product)
    "28_vector_ops", "117_vector_search2",
]


class _PortOnCpu(GreptimeDB):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("name", PORTED)
def test_golden_on_port(name, monkeypatch):
    monkeypatch.setattr(tg, "GreptimeDB", _PortOnCpu)
    got = tg._run_case(name)
    with open(os.path.join(tg.GOLDEN_DIR, name + ".result")) as f:
        want = f.read()
    assert tg._rows_match(got, want), (
        f"golden mismatch for {name} on the port\n--- got ---\n{got}"
        f"\n--- want ---\n{want}")


def test_listed_files_exist():
    assert len(set(PORTED)) == len(PORTED)
    assert set(PORTED) <= set(tg._cases())
