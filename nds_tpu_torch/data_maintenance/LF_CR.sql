-- LF_CR: catalog_returns refresh (TPC-DS spec 5.3.11).
-- Reference behavior: nds/data_maintenance/LF_CR.sql.
drop view if exists crv;
create temp view crv as
select d_date_sk cr_returned_date_sk,
       t_time_sk cr_returned_time_sk,
       i_item_sk cr_item_sk,
       c1.c_customer_sk cr_refunded_customer_sk,
       c1.c_current_cdemo_sk cr_refunded_cdemo_sk,
       c1.c_current_hdemo_sk cr_refunded_hdemo_sk,
       c1.c_current_addr_sk cr_refunded_addr_sk,
       c2.c_customer_sk cr_returning_customer_sk,
       c2.c_current_cdemo_sk cr_returning_cdemo_sk,
       c2.c_current_hdemo_sk cr_returning_hdemo_sk,
       c2.c_current_addr_sk cr_returning_addr_sk,
       cc_call_center_sk cr_call_center_sk,
       cp_catalog_page_sk cr_catalog_page_sk,
       sm_ship_mode_sk cr_ship_mode_sk,
       w_warehouse_sk cr_warehouse_sk,
       r_reason_sk cr_reason_sk,
       cret_order_id cr_order_number,
       cret_return_qty cr_return_quantity,
       cret_return_amt cr_return_amount,
       cret_return_tax cr_return_tax,
       cret_return_amt + cret_return_tax cr_return_amt_inc_tax,
       cret_return_fee cr_fee,
       cret_return_ship_cost cr_return_ship_cost,
       cret_refunded_cash cr_refunded_cash,
       cret_reversed_charge cr_reversed_charge,
       cret_merchant_credit cr_store_credit,
       cret_return_amt + cret_return_tax + cret_return_fee
         - cret_refunded_cash - cret_reversed_charge - cret_merchant_credit cr_net_loss
from s_catalog_returns
left outer join date_dim on (cast(cret_return_date as date) = d_date)
left outer join time_dim on ((cast(substr(cret_return_time, 1, 2) as integer) * 3600
                              + cast(substr(cret_return_time, 4, 2) as integer) * 60
                              + cast(substr(cret_return_time, 7, 2) as integer)) = t_time)
left outer join item on (cret_item_id = i_item_id)
left outer join customer c1 on (cret_return_customer_id = c1.c_customer_id)
left outer join customer c2 on (cret_refund_customer_id = c2.c_customer_id)
left outer join reason on (cret_reason_id = r_reason_id)
left outer join call_center on (cret_call_center_id = cc_call_center_id)
left outer join catalog_page on (cret_catalog_page_id = cp_catalog_page_id)
left outer join ship_mode on (cret_shipmode_id = sm_ship_mode_id)
left outer join warehouse on (cret_warehouse_id = w_warehouse_id)
where i_rec_end_date is null
  and cc_rec_end_date is null;
insert into catalog_returns (select * from crv order by cr_returned_date_sk);
